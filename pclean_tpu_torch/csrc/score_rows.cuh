// The one-row score kernels' shared pieces (K12 fk_score, K13
// choice_score): strided operands over the enumeration rows, the running
// (max, sum) pair of a logsumexp and its merge within a row's threads,
// and the rows' geometry: a warp or a block a row (K1's plan), or a
// thread a slot over a block or a cluster of blocks a row.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace score_rows {

constexpr int kMaxDims = 8;  // enumeration axes a record may have
constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 8;  // the portable cluster size
// the paths (ops.SCORE_PATHS): a warp a row, a block a row, a thread a
// slot over a block (grid (1, R)) or a cluster (grid (cluster, R))
enum { kWarp = 0, kBlock, kSlots };

// The R rows of a record are the row-major product of `nd` axes of
// `size`; an operand is read at sum_i coord_i * st_i (stride 0 on an
// axis it broadcasts over), then at its option-axis stride (a word of its
// own) along the option axis. Row 0 (every one-row record) is offset 0
// with no division; other rows walk the axes unrolled over kMaxDims, so
// that every axis is read at a constant index of the kernel's parameters.
__device__ __forceinline__ int64_t offset(int nd, const int64_t* size,
                                          const int64_t* st, int64_t r) {
  if (r == 0) return 0;
  int64_t off = 0;
#pragma unroll
  for (int i = kMaxDims - 1; i >= 0; --i) {
    if (i < nd && r != 0) {
      const int64_t n = size[i];
      off += (r % n) * st[i];
      r /= n;
    }
  }
  return off;
}

// A scalar of dtype code `dt` (ops._DT: 1 int8, 3 int16, 4 int32, 5
// int64, 6 float32) as a float, rounded to nearest as torch's
// .to(float32) rounds.
__device__ __forceinline__ float load_f32(const void* p, int dt, int64_t i) {
  switch (dt) {
    case 1: return (float)static_cast<const int8_t*>(p)[i];
    case 3: return (float)static_cast<const int16_t*>(p)[i];
    case 4: return (float)static_cast<const int32_t*>(p)[i];
    case 5: return (float)static_cast<const int64_t*>(p)[i];
    default: return static_cast<const float*>(p)[i];
  }
}

__device__ __forceinline__ int64_t load_i64(const void* p, int dt,
                                            int64_t i) {
  switch (dt) {
    case 1: return static_cast<const int8_t*>(p)[i];
    case 3: return static_cast<const int16_t*>(p)[i];
    case 4: return static_cast<const int32_t*>(p)[i];
    default: return static_cast<const int64_t*>(p)[i];
  }
}

// The running pair of a logsumexp: m the largest value seen, floored at
// NEG_INF (finite, so an all-NEG_INF stretch rescales by exp(0) and never
// by exp(-inf + inf)), s the sum of exp(x - m).
__device__ __forceinline__ void add(float& m, float& s, float x) {
  if (x > m) {
    s = s * expf(m - x) + 1.0f;
    m = x;
  } else {
    s += expf(x - m);
  }
}

__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                      float s2) {
  const float mx = fmaxf(m, m2);
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

// Every lane of the warp ends with the warp's merged pair.
__device__ __forceinline__ void warp_merge(float& m, float& s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    merge(m, s, m2, s2);
  }
}

// Thread 0 of a row's `tpr` threads ends with the row's pair: tpr = 32
// (a warp a row, no barrier) or the whole block (a block a row; every
// thread of the block must call it). `sh` holds 64 floats.
__device__ __forceinline__ void reduce(float& m, float& s, int tpr,
                                       float* sh) {
  warp_merge(m, s);
  if (tpr == 32) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sh[warp] = m;
    sh[32 + warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    const bool have = lane < (int)(blockDim.x >> 5);
    m = have ? sh[lane] : PCLEAN_NEG_INF;
    s = have ? sh[32 + lane] : 0.0f;
    warp_merge(m, s);
  }
}

// logZ with pclean_tpu.utils.logsumexp's finite NEG_INF rules (K1's).
__device__ __forceinline__ float finish(float m, float s) {
  const bool keep = isfinite(m) || (m > PCLEAN_NEG_INF / 2.0f);
  return keep ? logf(s) + m : PCLEAN_NEG_INF;
}

// A thread's row r and its place among the row's threads: t of T, the
// slots it takes t, t + T, ...; tpr the threads a block gives the row.
struct Row {
  int64_t r;
  int t, T, tpr;
};

__device__ __forceinline__ Row row_of(int path, int tpr) {
  Row x;
  if (path == kSlots) {
    x.r = blockIdx.y;
    x.t = blockIdx.x * blockDim.x + threadIdx.x;
    x.T = gridDim.x * blockDim.x;
    x.tpr = blockDim.x;
  } else {
    x.t = threadIdx.x % tpr;
    x.T = tpr;
    x.tpr = tpr;
    x.r = (int64_t)blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  }
  return x;
}

// The row's logZ from every thread's pair, written by the row's thread 0:
// the pairs merge by warp shuffles, shared memory (a block a row) and, on
// a cluster, in rank 0 through distributed shared memory. Every thread of
// the launch calls it.
__device__ __forceinline__ void row_logz(float m, float s, const Row& x,
                                         bool in, float* logz) {
  __shared__ float sh[64];
  __shared__ float clm[kMaxCluster], cls[kMaxCluster];
  reduce(m, s, x.tpr, sh);
  if (gridDim.x > 1 && x.T > x.tpr) {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    const unsigned rank = cluster.block_rank();
    if (threadIdx.x == 0) {
      *cluster.map_shared_rank(&clm[rank], 0) = m;
      *cluster.map_shared_rank(&cls[rank], 0) = s;
    }
    cluster.sync();  // release the writes above, acquire them in rank 0
    if (rank != 0 || threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    const bool have = lane < (int)cluster.num_blocks();
    m = have ? clm[lane] : PCLEAN_NEG_INF;
    s = have ? cls[lane] : 0.0f;
    warp_merge(m, s);
    if (in && lane == 0) logz[x.r] = finish(m, s);
    return;
  }
  if (in && x.t == 0) logz[x.r] = finish(m, s);
}

// Whether the host's geometry is one the kernels take for R rows: warp,
// threads = 32 rows, grid (>= ceil(R / rows), 1); block, one row a block,
// grid (R, 1); slots, grid (cluster, R) in clusters of `cluster`.
__host__ inline bool geometry_ok(int64_t path, int64_t tpr,
                                 int64_t cluster, int threads, int rows,
                                 int64_t grid_x, int64_t grid_y,
                                 int64_t R) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      rows < 1 || grid_x < 1 || grid_x > 2147483647ll || grid_y < 1 ||
      grid_y > 65535)
    return false;
  if (path == kWarp)
    return threads == 32 * rows && tpr == 32 && cluster == 1 &&
           grid_y == 1 && grid_x * rows >= R;
  if (path == kBlock)
    return rows == 1 && tpr == threads && cluster == 1 && grid_y == 1 &&
           grid_x == R;
  if (path == kSlots)
    return rows == 1 && cluster >= 1 && cluster <= kMaxCluster &&
           grid_x == cluster && grid_y == R;
  return false;
}

// Launches kernel(p) on the geometry, in clusters of `cluster` blocks
// along x where cluster > 1; returns the launch's error or
// cudaGetLastError() after it.
template <class P>
int launch_rows(void (*kernel)(P), const P& p, int threads, int cluster,
                int64_t grid_x, int64_t grid_y, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid_x, (unsigned)grid_y, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace score_rows
