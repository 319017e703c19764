// K1 enum_logsumexp: the block-enumeration record and its log-normalizer.
//
// Replaces, in pclean_tpu/engine/propose.py, the concat + logsumexp of
// BlockTracer.score_fk (propose.py:559-564: logits = [exist, new], kept as
// the record the sample pass draws from, logZ = logsumexp(logits)) and the
// per-value logsumexp of BlockTracer.score_choice (propose.py:517-519,
// record mode off: the caller keeps its own logits).
//
// Bound on the H100 (3.35 TB/s): bytes. fk mode reads R rows of K logits
// and R new values once and writes R*(K+1) record entries and R logZ:
// (R*K*4 + R*4 + R*(K+1)*4 + R*4) / 3.35e12 s. Choice mode reads R*K*4 and
// writes R*4. The exp per entry is far below the card's arithmetic rate.
//
// One read of the row. Every thread keeps a running pair (m, s): m the
// largest value seen, floored at NEG_INF (m starts there, finite, so an
// all-NEG_INF stretch rescales by exp(0) and never by exp(-inf + inf)), s
// the sum of exp(x - m). Each round of loads takes its max c first, then
// s = s * exp(m - c) + sum exp(x - c), without branches. A warp merges its
// pairs in three steps: the max (one integer redux.sync on an
// order-keeping map of the floats), each lane's s rescaled to it once,
// and a shuffle sum; blocks and clusters then merge the warps' pairs the
// same way. logZ = log(s) + m keeps pclean_tpu.utils.logsumexp's finite
// NEG_INF rules: an all-NEG_INF row gives log(K+1) + NEG_INF (= NEG_INF in
// f32), a row live only in `new` gives new's value.
//
// The row is cut into warp tiles of 128 floats, one 16-byte load a lane
// (a scalar head up to the row's first 16-byte boundary, a scalar tail of
// < 4 floats and the new value go to worker 0's lanes, loaded ahead of the
// tiles). A worker (one warp) takes tiles w, w + W, w + 2W, ... of its
// row, four tiles a round, so a lane has up to four 16-byte loads in
// flight; tiles past the row's end are skipped by the whole warp. Record
// rows have stride K + 1, so their 16-byte phase shifts from row to row
// and differs from the exist row's: each warp stages its tile in shared
// memory and writes it back out as four coalesced 128-byte runs of 4-byte
// stores. Choice mode is a separate instantiation without that code.
//
// At one row the kernel is a latency chain (the launch floor of a one-
// element PyTorch op on the card is ~0.0013 ms; PERF.md): loads are
// issued before anything waits on them, row-local indices are 32-bit,
// and no step branches on the data.
//
// Three paths; ops.enum_logsumexp_plan picks one and its geometry from
// (R, K, mode), and the entry point launches exactly that:
//   warp  (short rows, or many rows up to 2,048 long): one warp a row,
//         `rows` rows a block, no __syncthreads at all;
//   block (longer rows): one block a row, W = its warps, one
//         __syncthreads to merge the warps' pairs;
//   split (at most 8 rows longer than 8,192): a thread-block cluster of
//         `cluster` <= 8 blocks a row (cudaLaunchKernelEx with a cluster
//         dimension), W = all the cluster's warps. Each block merges its
//         pairs and writes the block's pair into rank 0's shared memory
//         (distributed shared memory); after one cluster.sync() rank 0
//         merges them and writes logZ. One launch: no atomics, no second
//         kernel, no scratch tensor.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxWarps = 16;  // 512 threads a block at most
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kRound = 4;       // warp tiles a worker loads at once
constexpr int kPathWarp = 0, kPathBlock = 1, kPathSplit = 2;
constexpr int64_t kMaxK = 1 << 30;  // row-local indices stay 32-bit

__device__ __forceinline__ float max4(float4 v) {
  return fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
}

// Float <-> int maps that keep the order of non-NaN floats, so that the
// warp's max is one integer redux.sync.
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// Every lane ends with the warp's pair: the warp's max first, then each
// lane's sum rescaled to it once, then the sum of those.
__device__ __forceinline__ void warp_ms(float& m, float& s) {
  const float mx = unordered(__reduce_max_sync(0xffffffffu, ordered(m)));
  s *= expf(m - mx);
  m = mx;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
}

// Thread 0 ends with the block's pair. `shm`, `shs` hold kMaxWarps floats.
__device__ __forceinline__ void block_ms(float& m, float& s, float* shm,
                                         float* shs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_ms(m, s);
  if (lane == 0) {
    shm[warp] = m;
    shs[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    const bool have = lane < (int)(blockDim.x >> 5);
    m = have ? shm[lane] : PCLEAN_NEG_INF;
    s = have ? shs[lane] : 0.0f;
    warp_ms(m, s);
  }
}

__device__ __forceinline__ float finish(float m, float s) {
  const bool keep = isfinite(m) || (m > PCLEAN_NEG_INF / 2.0f);
  return keep ? logf(s) + m : PCLEAN_NEG_INF;
}

// Worker w of W (one warp) adds its share of row x[0, K) (and `fresh`, for
// worker 0) into (m, s) and copies it (and `fresh`) into rec[0, K] when
// kRecord. `stage` is this warp's 32 float4 of shared memory. Row-local
// indices are 32-bit (the entry point bounds K). Warp-synchronous.
template <bool kRecord>
__device__ __forceinline__ void row_share(const float* __restrict__ x,
                                          float* __restrict__ rec,
                                          const float* fresh, int K, int w,
                                          int W, float4* stage, float& m,
                                          float& s) {
  const int lane = threadIdx.x & 31;
  const int phase = (int)((reinterpret_cast<uintptr_t>(x) >> 2) & 3);
  const int head = min((4 - phase) & 3, K);
  const int nvec = (K - head) >> 2;
  const int tiles = (nvec + 31) >> 5;
  const float4* x4 = reinterpret_cast<const float4*>(x + head);
  const float* sf = reinterpret_cast<const float*>(stage);

  // Worker 0's lanes take the head (< 4 floats), the tail (< 4) and the
  // new value (k = K), one each, loaded ahead of the tiles.
  int k = -1;
  if (w == 0) {
    const int tail0 = head + 4 * nvec;
    if (lane < head)
      k = lane;
    else if (lane >= 4 && lane < 8 && tail0 + lane - 4 < K)
      k = tail0 + lane - 4;
    else if (kRecord && lane == 8)
      k = K;
  }
  const float sv = k < 0 ? -INFINITY : (k < K ? x[k] : *fresh);

  // the lane's scalar joins the first round (-inf where it has none:
  // exp(-inf) = 0), or is merged alone where the worker has no tile
  float pend = sv;
  for (int t0 = w; t0 < tiles; t0 += kRound * W) {
    float4 v[kRound];
    float c = fmaxf(m, pend);
#pragma unroll
    for (int u = 0; u < kRound; ++u) {
      // tiles past the row's end are skipped by the whole warp
      const int t = t0 + u * W, i = t * 32 + lane;
      v[u] = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      if (t < tiles && i < nvec) v[u] = __ldg(x4 + i);
      c = fmaxf(c, max4(v[u]));
    }
    float add = expf(pend - c);
    pend = -INFINITY;
#pragma unroll
    for (int u = 0; u < kRound; ++u)
      if (t0 + u * W < tiles)
        add += (expf(v[u].x - c) + expf(v[u].y - c)) +
               (expf(v[u].z - c) + expf(v[u].w - c));
    s = s * expf(m - c) + add;  // m <= c; exp(0) = 1 where they are equal
    m = c;
    if constexpr (kRecord) {
#pragma unroll
      for (int u = 0; u < kRound; ++u) {
        const int t = t0 + u * W;
        if (t >= tiles) break;  // the same for the whole warp
        stage[lane] = v[u];
        __syncwarp();
        float* out = rec + head + t * 128;
        const int left = 4 * nvec - t * 128;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (32 * j + lane < left) out[32 * j + lane] = sf[32 * j + lane];
        __syncwarp();
      }
    }
  }
  if (w >= tiles) {  // the same for the whole warp
    const float c = fmaxf(m, pend);
    s = s * expf(m - c) + expf(pend - c);
    m = c;
  }
  if (kRecord && k >= 0) rec[k] = sv;
}

template <int kPath, bool kRecord>
__global__ void __launch_bounds__(kMaxWarps * 32)
enum_logsumexp_kernel(const float* __restrict__ exist,
                      const float* __restrict__ fresh,
                      float* __restrict__ record, float* __restrict__ logz,
                      int64_t R, int64_t K) {
  __shared__ float4 stage[kMaxWarps][32];
  __shared__ float shm[kMaxWarps], shs[kMaxWarps];
  __shared__ float clm[kMaxCluster], cls[kMaxCluster];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int64_t row;
  int w, W;
  if constexpr (kPath == kPathWarp) {
    row = (int64_t)blockIdx.x * nwarps + warp;
    if (row >= R) return;  // the whole warp
    w = 0;
    W = 1;
  } else if constexpr (kPath == kPathBlock) {
    row = blockIdx.x;
    w = warp;
    W = nwarps;
  } else {
    row = blockIdx.y;
    w = blockIdx.x * nwarps + warp;
    W = gridDim.x * nwarps;
  }
  float m = PCLEAN_NEG_INF, s = 0.0f;
  row_share<kRecord>(exist + row * K,
                     kRecord ? record + row * (K + 1) : nullptr,
                     kRecord ? fresh + row : nullptr, (int)K, w, W,
                     stage[warp], m, s);

  if constexpr (kPath == kPathWarp) {
    warp_ms(m, s);
    if (lane == 0) logz[row] = finish(m, s);
  } else if constexpr (kPath == kPathBlock) {
    block_ms(m, s, shm, shs);
    if (threadIdx.x == 0) logz[row] = finish(m, s);
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    block_ms(m, s, shm, shs);
    const unsigned rank = cluster.block_rank();
    if (threadIdx.x == 0) {
      *cluster.map_shared_rank(&clm[rank], 0) = m;
      *cluster.map_shared_rank(&cls[rank], 0) = s;
    }
    cluster.sync();  // release the writes above, acquire them in rank 0
    if (rank == 0 && warp == 0) {
      const bool have = lane < (int)cluster.num_blocks();
      m = have ? clm[lane] : PCLEAN_NEG_INF;
      s = have ? cls[lane] : 0.0f;
      warp_ms(m, s);
      if (lane == 0) logz[row] = finish(m, s);
    }
  }
}

// Launches the plan's grid; a cluster of `cluster` blocks along x on the
// split path.
template <int kPath, bool kRecord>
cudaError_t launch(const float* exist, const float* fresh, float* record,
                   float* logz, int64_t R, int64_t K, int threads,
                   int cluster, int64_t grid_x, int64_t grid_y,
                   cudaStream_t st) {
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y, 1);
  if constexpr (kPath == kPathSplit) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3((unsigned)threads, 1, 1);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e =
        cudaLaunchKernelEx(&cfg, enum_logsumexp_kernel<kPath, kRecord>,
                           exist, fresh, record, logz, R, K);
    if (e != cudaSuccess) return e;
  } else {
    enum_logsumexp_kernel<kPath, kRecord><<<grid, threads, 0, st>>>(
        exist, fresh, record, logz, R, K);
  }
  return cudaGetLastError();
}

template <int kPath>
cudaError_t launch_mode(const float* exist, const float* fresh,
                        float* record, float* logz, int64_t R, int64_t K,
                        int threads, int cluster, int64_t grid_x,
                        int64_t grid_y, cudaStream_t st) {
  if (record != nullptr)
    return launch<kPath, true>(exist, fresh, record, logz, R, K, threads,
                               cluster, grid_x, grid_y, st);
  return launch<kPath, false>(exist, fresh, record, logz, R, K, threads,
                              cluster, grid_x, grid_y, st);
}

}  // namespace

// exist [R, K] f32, fresh [R] f32 or null, record [R, K+1] f32 or null
// (null exactly when fresh is null: choice mode), logz [R] f32. All
// contiguous. The plan (ops.enum_logsumexp_plan): path 0 warp (threads =
// 32 * rows, grid (ceil(R / rows), 1)), 1 block (rows 1, grid (R, 1)), 2
// split (rows 1, grid (cluster, R), clusters of `cluster` blocks along x).
// Returns cudaErrorInvalidValue for a plan it does not take, else the
// launch's error or cudaGetLastError() after it (a refused cluster launch
// included).
extern "C" int pclean_enum_logsumexp(const float* exist, const float* fresh,
                                     float* record, float* logz, int64_t R,
                                     int64_t K, int path, int threads,
                                     int rows, int cluster, int64_t grid_x,
                                     int64_t grid_y, void* stream) {
  if (threads < 32 || threads > kMaxWarps * 32 || threads % 32 != 0 ||
      K < 0 || K > kMaxK || R < 0 ||
      (fresh == nullptr) != (record == nullptr))
    return (int)cudaErrorInvalidValue;
  bool ok;
  if (path == kPathWarp)
    ok = threads == 32 * rows && cluster == 1 && grid_y == 1 &&
         grid_x * rows >= R && (grid_x - 1) * rows < R;
  else if (path == kPathBlock)
    ok = rows == 1 && cluster == 1 && grid_x == R && grid_y == 1;
  else if (path == kPathSplit)
    ok = rows == 1 && cluster >= 1 && cluster <= kMaxCluster &&
         grid_x == cluster && grid_y == R && grid_y <= 65535;
  else
    ok = false;
  if (!ok) return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (path == kPathWarp)
    e = launch_mode<kPathWarp>(exist, fresh, record, logz, R, K, threads,
                               cluster, grid_x, grid_y, st);
  else if (path == kPathBlock)
    e = launch_mode<kPathBlock>(exist, fresh, record, logz, R, K, threads,
                                cluster, grid_x, grid_y, st);
  else
    e = launch_mode<kPathSplit>(exist, fresh, record, logz, R, K, threads,
                                cluster, grid_x, grid_y, st);
  return (int)e;
}
