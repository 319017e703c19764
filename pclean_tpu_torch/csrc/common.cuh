// Block-wide reductions and the byte-mask walk shared by the port's kernels.
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

// Zeroes the bytes of `v` (loaded from address a) outside [lo, hi).
__device__ __forceinline__ uint4 pclean_mask_word(uint4 v, uintptr_t a,
                                                  uintptr_t lo,
                                                  uintptr_t hi) {
  uint32_t c[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 16; ++k)
    if (a + k < lo || a + k >= hi) c[k >> 2] &= ~(0xffu << (8 * (k & 3)));
  return make_uint4(c[0], c[1], c[2], c[3]);
}

// Referrers a warp reads a step of pclean_walk: 32 lanes x 16 bytes.
#define PCLEAN_SPAN 512

// Walks the set bytes of the byte mask w[lo, hi) with the block's kWarps
// warps, a 512-byte span a warp and step (16-byte aligned words, so a row
// that starts or ends inside a word has the bytes outside [lo, hi) masked;
// an aligned word never leaves the allocation's 16-byte granules), and
// calls count(r0, set) for every span with a set byte: bit j of `set` says
// that referrer r0 + 32 j is set (r0 = the span's start + lane, counted in
// bytes from w). A span with no set byte costs one warp vote. Warp k takes
// spans k, k + kWarps, ... in order; each lane issues the loads of kDepth
// of its spans together before it votes on the first, so a warp keeps
// kDepth x 512 bytes in flight. With kStream the words are loaded as
// streaming data (ld.global.cs, evict-first), so a mask read once does not
// push out of L2 what the callback reads again. Every lane of the warp
// makes the call, so the callback may use warp collectives. `stage` is the
// warp's own 32 uint4.
template <int kWarps, int kDepth = 1, bool kStream = false, class F>
__device__ __forceinline__ void pclean_walk(const uint8_t* __restrict__ w,
                                            int64_t lo, int64_t hi,
                                            uint4* stage, F&& count) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uintptr_t base = reinterpret_cast<uintptr_t>(w);
  const uintptr_t a_lo = base + lo, a_hi = base + hi;
  const uintptr_t first = a_lo & ~(uintptr_t)15;
  constexpr uintptr_t kStride = (uintptr_t)kWarps * PCLEAN_SPAN;
  for (uintptr_t s0 = first + (uintptr_t)warp * PCLEAN_SPAN; s0 < a_hi;
       s0 += kDepth * kStride) {
    uint4 words[kDepth];
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const uintptr_t a = s0 + d * kStride + 16 * lane;
      words[d] = make_uint4(0, 0, 0, 0);
      if (a < a_hi) {
        const uint4* p = reinterpret_cast<const uint4*>(a);
        words[d] = kStream ? __ldcs(p) : __ldg(p);
        if (a < a_lo || a + 16 > a_hi)
          words[d] = pclean_mask_word(words[d], a, a_lo, a_hi);
      }
    }
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const uint4 word = words[d];
      const bool any = (word.x | word.y | word.z | word.w) != 0u;
      if (__ballot_sync(0xffffffffu, any) == 0u) continue;
      stage[lane] = word;
      __syncwarp();
      const uint8_t* bytes = reinterpret_cast<const uint8_t*>(stage);
      uint32_t set = 0;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        set |= (bytes[32 * j + lane] != 0 ? 1u : 0u) << j;
      __syncwarp();
      count((int64_t)(s0 + d * kStride - base) + lane, set);
    }
  }
}
