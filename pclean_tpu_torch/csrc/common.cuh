// Block-wide reductions shared by the port's kernels.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// pclean_tpu.utils.NEG_INF: the finite stand-in for -inf in masked sums.
#define PCLEAN_NEG_INF (-1e30f)

__device__ __forceinline__ float pclean_warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float pclean_warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int pclean_warp_sum_int(int v) {
  for (int o = 16; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Every thread of the block gets the result. `sh` holds >= 33 floats.
// blockDim.x must be a multiple of 32.
__device__ __forceinline__ float pclean_block_max(float v, float* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = pclean_warp_max(v);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nwarps ? sh[lane] : -INFINITY;
    w = pclean_warp_max(w);
    if (lane == 0) sh[32] = w;
  }
  __syncthreads();
  const float r = sh[32];
  __syncthreads();
  return r;
}

__device__ __forceinline__ float pclean_block_sum(float v, float* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = pclean_warp_sum(v);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nwarps ? sh[lane] : 0.0f;
    w = pclean_warp_sum(w);
    if (lane == 0) sh[32] = w;
  }
  __syncthreads();
  const float r = sh[32];
  __syncthreads();
  return r;
}

__device__ __forceinline__ int pclean_block_sum_int(int v, int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = pclean_warp_sum_int(v);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? sh[lane] : 0;
    w = pclean_warp_sum_int(w);
    if (lane == 0) sh[32] = w;
  }
  __syncthreads();
  const int r = sh[32];
  __syncthreads();
  return r;
}
